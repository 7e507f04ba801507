"""Synthetic document corpora with exact ground truth (DESIGN.md §8.4).

Three corpora styled after the paper's datasets (Table 1):
  - wiki : 200 docs, multi-domain (players/teams/cities/owners + movie and
           company distractor domains), ~1.2k tokens/doc, joinable tables.
  - legal: 100 long single-domain case reports, ~6k tokens/doc (LCR-style).
  - swde : 200 short attribute-dense pages (universities + laptops).

Each attribute has paired sentence *templates* (rendering) and a *pattern*
(extraction oracle); values are planted in exactly one sentence per document
and recorded as spans, so retrieval quality — not parsing luck — drives
accuracy, mirroring the paper's controlled variable.

Tables map a queried logical table to the *whole collection*: the
document-level index (not table metadata) must discover which documents are
relevant — this is precisely the paper's two-level-index setting.
"""
from __future__ import annotations

import random
import re
from dataclasses import dataclass, field
from typing import Any, Callable

from .tokens import count_tokens


@dataclass
class AttrSpec:
    name: str
    kind: str                    # 'int' | 'float' | 'str'
    desc: str
    templates: list[str]         # each with one {} slot for the value
    pattern: str                 # regex with one capture group
    sampler: Callable[[random.Random], Any] = None

    def parse(self, text: str):
        m = re.search(self.pattern, text)
        if not m:
            return None
        raw = m.group(1)
        if self.kind == "int":
            return int(raw)
        if self.kind == "float":
            return float(raw)
        return raw.strip()


@dataclass
class Document:
    doc_id: str
    domain: str
    text: str
    truth: dict = field(default_factory=dict)   # attr -> value
    spans: dict = field(default_factory=dict)   # attr -> sentence containing it
    tokens: int = 0
    # live-corpus manifest identity (repro.live, DESIGN.md §17): version
    # bumps per mutation, sha is the blake2b-128 content hash of `text`.
    # Static corpora keep version 0 / sha "" until wrapped in a LiveCorpus.
    version: int = 0
    sha: str = ""
    # retriever protocol expects .table = owning domain
    @property
    def table(self):
        return self.domain


@dataclass
class Corpus:
    name: str
    docs: dict                    # doc_id -> Document
    tables: dict                  # logical table -> [doc_ids] (candidate pool)
    attr_specs: dict              # table -> {attr: AttrSpec}
    domain_of_table: dict         # logical table -> truth domain

    def attr_description(self, table: str, attr: str) -> str:
        spec = self.attr_specs.get(table, {}).get(attr)
        return spec.desc if spec else attr

    def spec(self, domain: str, attr: str) -> AttrSpec | None:
        for t, d in self.domain_of_table.items():
            if d == domain and attr in self.attr_specs.get(t, {}):
                return self.attr_specs[t][attr]
        return None

    def truth_rows(self, table: str) -> dict:
        """doc_id -> truth dict for docs belonging to the table's domain."""
        dom = self.domain_of_table[table]
        return {d: doc.truth for d, doc in self.docs.items() if doc.domain == dom}

    def subset(self, doc_ids) -> "Corpus":
        """Restrict to `doc_ids` (CI-sized workloads). Every table keeps
        the full restricted pool as candidates — like the generators, table
        membership stays something the index must discover, not a given."""
        ids = [d for d in doc_ids if d in self.docs]
        return Corpus(f"{self.name}-subset", {d: self.docs[d] for d in ids},
                      {t: list(ids) for t in self.tables}, self.attr_specs,
                      self.domain_of_table)


# --------------------------------------------------------------- helpers ---

FIRST = ["James", "Maria", "Wei", "Aisha", "Carlos", "Elena", "Tom", "Priya",
         "Jamal", "Sofia", "Liam", "Nina", "Omar", "Grace", "Hugo", "Ivy",
         "Ken", "Lara", "Marco", "Noor", "Pablo", "Rosa", "Sven", "Tara"]
LAST = ["Walker", "Chen", "Garcia", "Okafor", "Silva", "Novak", "Kim", "Patel",
        "Johnson", "Mbeki", "Larsen", "Ortiz", "Tanaka", "Weber", "Diaz",
        "Kovac", "Brown", "Rossi", "Ahmed", "Nilsson"]
CITY_NAMES = ["Austin", "Riverton", "Lakemont", "Harborview", "Stonefield",
              "Brookside", "Fairhaven", "Mapleton", "Crestwood", "Seaport",
              "Northgate", "Eastvale", "Westbrook", "Southridge", "Pinehurst",
              "Oakland Hills", "Silver Falls", "Granite Bay", "Sunfield", "Moss Point"]
MASCOTS = ["Falcons", "Tigers", "Comets", "Raptors", "Wolves", "Hornets",
           "Pioneers", "Storm", "Titans", "Mariners", "Blazers", "Cyclones"]
STATES = ["Texas", "Ohio", "Nevada", "Oregon", "Georgia", "Maine", "Utah",
          "Kansas", "Iowa", "Vermont"]
COUNTRIES = ["American", "Spanish", "Nigerian", "Brazilian", "Croatian",
             "Japanese", "German", "Canadian", "French", "Australian"]
POSITIONS = ["point guard", "shooting guard", "small forward", "power forward", "center"]
CRIMES = ["fraud", "burglary", "assault", "embezzlement", "arson", "smuggling"]
COURTS = ["District Court of Riverton", "Lakemont Court of Appeals",
          "Harborview Superior Court", "Stonefield Circuit Court",
          "Fairhaven High Court", "Northgate Criminal Court"]

FILLER = {
    "sports": [
        "The season drew record attendance across the league.",
        "Analysts praised the coaching staff for disciplined rotations.",
        "Local media covered the preseason workouts extensively.",
        "Ticket demand surged ahead of the conference finals.",
        "The franchise invested heavily in its development program.",
        "Broadcast ratings climbed steadily through the playoffs.",
        "A new practice facility opened to the public last spring.",
        "Supporters organized community events throughout the year.",
    ],
    "finance": [
        "Portfolio allocations shifted toward fixed income last quarter.",
        "The holding company restructured its venture arm.",
        "Dividend policy remained unchanged despite market turbulence.",
        "Philanthropic pledges were announced at the annual gala.",
        "Advisors highlighted exposure to emerging markets.",
        "The family office expanded its real estate positions.",
        "Regulatory filings disclosed several new board seats.",
    ],
    "civic": [
        "The council approved a new transit corridor in spring.",
        "Municipal bonds funded the riverfront restoration project.",
        "Residents gathered for the annual harvest festival downtown.",
        "Zoning reforms opened several districts to mixed use.",
        "The public library extended weekend opening hours.",
        "Road maintenance crews completed the bridge resurfacing.",
    ],
    "cinema": [
        "Principal photography wrapped after a demanding schedule.",
        "Critics praised the cinematography in festival screenings.",
        "The score was recorded with a full orchestra.",
        "Early previews generated strong word of mouth.",
        "The studio confirmed a streaming release window.",
        "Casting announcements drew considerable press attention.",
    ],
    "corporate": [
        "Quarterly guidance was revised upward on strong demand.",
        "The board approved a share buyback program.",
        "Supply chain constraints eased through the second half.",
        "A new logistics hub opened near the coast.",
        "The sustainability report outlined emission targets.",
        "Management reiterated its hiring plans for engineering.",
    ],
    "legal": [
        "The hearing proceeded without interruption before a full gallery.",
        "Counsel for the defense submitted supplementary briefs.",
        "Procedural motions occupied much of the morning session.",
        "The clerk recorded exhibits into the permanent docket.",
        "Witness testimony continued into the late afternoon.",
        "The prosecution rested after presenting forensic analysis.",
        "Jury selection had concluded earlier that week.",
        "Observers noted the unusual length of deliberations.",
        "The bailiff maintained order during the announcement.",
        "Several continuances had delayed the original schedule.",
    ],
    "web": [
        "The campus tour is offered twice daily during term.",
        "Visitors can find directions and parking details online.",
        "The newsletter highlights alumni achievements quarterly.",
        "Frequently asked questions are answered on the portal.",
        "The office responds to inquiries within two business days.",
    ],
}


def _sent_join(rng: random.Random, planted: list[str], filler_pool: list[str],
               n_filler: int) -> tuple[str, list[str]]:
    filler = [rng.choice(filler_pool) for _ in range(n_filler)]
    sents = planted + filler
    rng.shuffle(sents)
    return " ".join(sents), sents


def _render_doc(rng: random.Random, doc_id: str, domain: str,
                specs: dict, values: dict, filler_pool: list[str],
                n_filler: int, intro: str) -> Document:
    planted, spans = [], {}
    for attr, spec in specs.items():
        v = values[attr]
        t = rng.choice(spec.templates)
        sent = t.format(v)
        planted.append(sent)
        spans[attr] = sent
    body, _ = _sent_join(rng, planted, filler_pool, n_filler)
    text = f"{intro} {body}"
    d = Document(doc_id, domain, text, dict(values), spans)
    d.tokens = count_tokens(text)
    return d


# ------------------------------------------------------------ wiki corpus --


def _wiki_specs():
    players = {
        "player_name": AttrSpec("player_name", "str", "Full name of the basketball player.",
            ["The player profiled here is {}.", "This article covers the career of {}."],
            r"(?:profiled here is|covers the career of) ([A-Z][a-z]+ [A-Z][a-zA-Z]+)"),
        "age": AttrSpec("age", "int", "Player's age in years.",
            ["He is {} years old.", "At {} years of age, he remains a regular starter."],
            r"(?:He is|At) (\d+) years (?:old|of age)"),
        "team_name": AttrSpec("team_name", "str", "Name of the team the player currently plays for.",
            ["He currently plays for the {}.", "His current club is the {}."],
            r"(?:plays for the|current club is the) ([A-Z][a-zA-Z]+(?: [A-Z][a-zA-Z]+)*)\."),
        "all_stars": AttrSpec("all_stars", "int", "Number of All-Star selections earned.",
            ["He has earned {} All-Star selections.", "His resume includes {} All-Star selections."],
            r"(\d+) All-Star selections"),
        "ppg": AttrSpec("ppg", "float", "Career scoring average in points per game.",
            ["He averages {} points per game.", "His scoring average stands at {} points per game."],
            r"(\d+\.\d) points per game"),
        "position": AttrSpec("position", "str", "Playing position on the court.",
            ["His listed position is {}.", "Scouts describe his position as {}."],
            r"position (?:is|as) (point guard|shooting guard|small forward|power forward|center)"),
        "nationality": AttrSpec("nationality", "str", "Player's nationality.",
            ["He holds {} nationality.", "By nationality he is {}."],
            r"(?:holds|he is) ([A-Z][a-z]+)(?: nationality)?\."),
    }
    teams = {
        "team_name": AttrSpec("team_name", "str", "Official name of the basketball team.",
            ["This page describes the franchise known as the {}.",
             "The franchise documented here is the {}."],
            r"(?:known as the|documented here is the) ([A-Z][a-zA-Z]+(?: [A-Z][a-zA-Z]+)*)\."),
        "championships": AttrSpec("championships", "int", "Number of championships the team has won.",
            ["The club has captured {} championships.", "Its trophy cabinet holds {} championships."],
            r"(\d+) championships"),
        "location": AttrSpec("location", "str", "Home city where the team is based.",
            ["The team is based in the city of {}.", "Home games are hosted in the city of {}."],
            r"(?:based in|hosted in) the city of ([A-Z][a-zA-Z]+(?: [A-Z][a-zA-Z]+)*)\."),
        "owner_name": AttrSpec("owner_name", "str", "Name of the team's principal owner.",
            ["The principal owner of the club is {}.", "Ownership rests with {}."],
            r"(?:principal owner of the club is|Ownership rests with) ([A-Z][a-z]+ [A-Z][a-zA-Z]+)"),
        "founded": AttrSpec("founded", "int", "Year the team was founded.",
            ["The organization was founded in {}.", "Established in {}, the club has deep roots."],
            r"(?:founded in|Established in) (\d{4})"),
        "arena_capacity": AttrSpec("arena_capacity", "int", "Seating capacity of the team's arena.",
            ["Its arena seats {} spectators.", "The home arena accommodates {} spectators."],
            r"(?:seats|accommodates) (\d+) spectators"),
    }
    cities = {
        "city_name": AttrSpec("city_name", "str", "Name of the city.",
            ["This entry concerns the municipality of {}.", "The city chronicled here is {}."],
            r"(?:municipality of|chronicled here is) ([A-Z][a-zA-Z]+(?: [A-Z][a-zA-Z]+)*)\."),
        "population": AttrSpec("population", "int", "Resident population of the city.",
            ["The resident population totals {}.", "Census figures put the population at {}."],
            r"population (?:totals|at) (\d+)"),
        "state": AttrSpec("state", "str", "State in which the city lies.",
            ["It lies within the state of {}.", "Administratively it belongs to the state of {}."],
            r"state of ([A-Z][a-z]+)"),
        "founded_year": AttrSpec("founded_year", "int", "Year of incorporation of the city.",
            ["The settlement was incorporated in {}.", "Incorporation dates to {}."],
            r"(?:incorporated in|Incorporation dates to) (\d{4})"),
    }
    owners = {
        "owner_name": AttrSpec("owner_name", "str", "Full name of the business figure.",
            ["This biography belongs to {}.", "The subject of this biography is {}."],
            r"(?:biography belongs to|biography is) ([A-Z][a-z]+ [A-Z][a-zA-Z]+)"),
        "net_worth": AttrSpec("net_worth", "float", "Estimated net worth in billions of dollars.",
            ["Estimates place the net worth near {} billion dollars.",
             "Financial outlets report a net worth of {} billion dollars."],
            r"net worth (?:near|of) (\d+\.\d) billion"),
        # NOTE: first template intentionally shared with players.age — real
        # corpora overlap lexically across domains; this is what makes the
        # document-level index earn its keep (segment-only pays for it).
        "owner_age": AttrSpec("owner_age", "int", "Age of the business figure.",
            ["He is {} years old.", "Now {} years old, the investor stays active."],
            r"(?:He is|Now) (\d+) years old"),
        "industry": AttrSpec("industry", "str", "Primary industry of the owner's fortune.",
            ["The fortune originates from the {} industry.",
             "Most holdings concentrate in the {} industry."],
            r"(?:from|in) the ([a-z]+) industry"),
    }
    movies = {
        "title": AttrSpec("title", "str", "Movie title.",
            ["The film reviewed here is {}.", "This synopsis covers the film {}."],
            r"film (?:reviewed here is|covers the film)? ?([A-Z][a-zA-Z ]+)\."),
        "box_office": AttrSpec("box_office", "int", "Worldwide box office gross in millions.",
            ["Worldwide grosses reached {} million.", "It earned {} million at the box office."],
            r"(\d+) million"),
        "director_name": AttrSpec("director_name", "str", "Name of the film's director.",
            ["Direction was handled by {}.", "It was directed by {}."],
            r"(?:handled by|directed by) ([A-Z][a-z]+ [A-Z][a-zA-Z]+)"),
    }
    companies = {
        "company_name": AttrSpec("company_name", "str", "Registered company name.",
            ["The corporation profiled is {}.", "This report examines {}."],
            r"(?:corporation profiled is|report examines) ([A-Z][a-zA-Z]+(?: [A-Z][a-zA-Z]+)*)\."),
        "revenue": AttrSpec("revenue", "float", "Annual revenue in billions of dollars.",
            ["Annual revenue reached {} billion dollars.", "It reported revenue of {} billion dollars."],
            r"revenue (?:reached|of) (\d+\.\d) billion"),
        "employees": AttrSpec("employees", "int", "Number of employees.",
            ["The workforce numbers {} employees.", "It employs {} employees worldwide."],
            r"(\d+) employees"),
    }
    return {"players": players, "teams": teams, "cities": cities,
            "owners": owners, "movies": movies, "companies": companies}


def make_wiki_corpus(seed: int = 0) -> Corpus:
    rng = random.Random(seed)
    specs = _wiki_specs()
    docs: dict = {}

    def uniq_names(n, maker):
        out = []
        seen = set()
        while len(out) < n:
            v = maker()
            if v not in seen:
                seen.add(v)
                out.append(v)
        return out

    city_vals = uniq_names(20, lambda: rng.choice(CITY_NAMES))
    team_vals = uniq_names(24, lambda: f"{rng.choice(CITY_NAMES).split()[0]} {rng.choice(MASCOTS)}")
    owner_vals = uniq_names(20, lambda: f"{rng.choice(FIRST)} {rng.choice(LAST)}")
    player_vals = uniq_names(60, lambda: f"{rng.choice(FIRST)} {rng.choice(LAST)}")

    def add(domain, i, values, intro, n_filler=10):
        doc_id = f"wiki/{domain}/{i:03d}"
        pool = {"players": "sports", "teams": "sports", "cities": "civic",
                "owners": "finance", "movies": "cinema", "companies": "corporate"}[domain]
        docs[doc_id] = _render_doc(rng, doc_id, domain, specs_map[domain],
                                   values, FILLER[pool], n_filler, intro)

    specs_map = specs
    for i, cname in enumerate(city_vals):
        add("cities", i, {
            "city_name": cname,
            "population": rng.randrange(40_000, 2_000_000, 1000),
            "state": rng.choice(STATES),
            "founded_year": rng.randint(1790, 1920),
        }, "An overview of a mid-sized municipality follows.")
    for i, tname in enumerate(team_vals):
        add("teams", i, {
            "team_name": tname,
            "championships": rng.randint(0, 18),
            "location": rng.choice(city_vals),
            "owner_name": rng.choice(owner_vals),
            "founded": rng.randint(1946, 2002),
            "arena_capacity": rng.randrange(15_000, 22_000, 100),
        }, "A franchise history page follows.")
    for i, oname in enumerate(owner_vals):
        add("owners", i, {
            "owner_name": oname,
            "net_worth": round(rng.uniform(1.0, 40.0), 1),
            "owner_age": rng.randint(38, 88),
            "industry": rng.choice(["software", "energy", "media", "finance", "retail"]),
        }, "A biography of a prominent business figure follows.")
    for i, pname in enumerate(player_vals):
        add("players", i, {
            "player_name": pname,
            "age": rng.randint(19, 42),
            "team_name": rng.choice(team_vals),
            "all_stars": rng.randint(0, 15),
            "ppg": round(rng.uniform(2.0, 32.0), 1),
            "position": rng.choice(POSITIONS),
            "nationality": rng.choice(COUNTRIES),
        }, "A profile of a professional athlete follows.")
    for i in range(38):
        add("movies", i, {
            "title": " ".join(w.title() for w in rng.sample(
                ["silent", "river", "echo", "crimson", "harvest", "orbit",
                 "glass", "ember", "northern", "voyage"], 2)),
            "box_office": rng.randrange(20, 900),
            "director_name": f"{rng.choice(FIRST)} {rng.choice(LAST)}",
        }, "A film synopsis follows.")
    for i in range(38):
        add("companies", i, {
            "company_name": f"{rng.choice(CITY_NAMES).split()[0]} {rng.choice(['Dynamics', 'Systems', 'Holdings', 'Labs', 'Group'])}",
            "revenue": round(rng.uniform(0.5, 90.0), 1),
            "employees": rng.randrange(200, 150_000, 100),
        }, "A corporate overview follows.")

    all_ids = sorted(docs)
    tables = {t: list(all_ids) for t in specs}
    return Corpus("wiki", docs, tables, specs, {t: t for t in specs})


# ----------------------------------------------------------- legal corpus --


def _legal_specs():
    return {"cases": {
        "case_number": AttrSpec("case_number", "str", "Docket number of the case.",
            ["The matter is registered under docket {}.", "Filed under docket {}, the case drew attention."],
            r"docket ([A-Z]{2}-\d{4}-\d{3})"),
        "court": AttrSpec("court", "str", "Court where the case was heard.",
            ["Proceedings took place at the {}.", "The matter was heard at the {}."],
            r"(?:took place at|heard at) the ([A-Z][a-zA-Z ]+Court(?: of [A-Z][a-z]+)?)"),
        "judge": AttrSpec("judge", "str", "Name of the presiding judge.",
            ["Presiding over the bench was Judge {}.", "The honorable Judge {} presided."],
            r"Judge ([A-Z][a-z]+ [A-Z][a-zA-Z]+)"),
        "year": AttrSpec("year", "int", "Year the judgment was delivered.",
            ["Judgment was delivered in {}.", "The final ruling came down in {}."],
            r"(?:delivered in|came down in) (\d{4})"),
        "charges": AttrSpec("charges", "int", "Number of charges brought against the defendant.",
            ["The indictment listed {} charges.", "Prosecutors filed {} charges in total."],
            r"(\d+) charges"),
        "sentence_years": AttrSpec("sentence_years", "int", "Custodial sentence length in years.",
            ["The court imposed a sentence of {} years.", "A custodial term of {} years was handed down."],
            r"(?:sentence of|custodial term of) (\d+) years"),
        "crime_type": AttrSpec("crime_type", "str", "Primary category of the offence.",
            ["The principal offence was classified as {}.", "Charges centered on allegations of {}."],
            r"(?:classified as|allegations of) (fraud|burglary|assault|embezzlement|arson|smuggling)"),
        "appeal": AttrSpec("appeal", "str", "Whether an appeal was lodged (yes/no).",
            ["An appeal was lodged: {}.", "Appeal status recorded as {}."],
            r"(?:appeal was lodged: |Appeal status recorded as )(yes|no)"),
        "defendant": AttrSpec("defendant", "str", "Name of the defendant.",
            ["The defendant named in the indictment is {}.", "Proceedings were brought against {}."],
            r"(?:indictment is|brought against) ([A-Z][a-z]+ [A-Z][a-zA-Z]+)"),
        "fine_amount": AttrSpec("fine_amount", "int", "Monetary fine in thousands of dollars.",
            ["A fine of {} thousand dollars accompanied the sentence.",
             "The court additionally levied {} thousand dollars."],
            r"(?:fine of|levied) (\d+) thousand dollars"),
    }}


def make_legal_corpus(seed: int = 1) -> Corpus:
    rng = random.Random(seed)
    specs = _legal_specs()
    docs = {}
    for i in range(100):
        doc_id = f"legal/cases/{i:03d}"
        values = {
            "case_number": f"{rng.choice(['CR', 'CV', 'AP'])}-{rng.randint(2004, 2024)}-{rng.randint(100, 999)}",
            "court": rng.choice(COURTS),
            "judge": f"{rng.choice(FIRST)} {rng.choice(LAST)}",
            "year": rng.randint(2004, 2024),
            "charges": rng.randint(1, 12),
            "sentence_years": rng.randint(0, 30),
            "crime_type": rng.choice(CRIMES),
            "appeal": rng.choice(["yes", "no"]),
            "defendant": f"{rng.choice(FIRST)} {rng.choice(LAST)}",
            "fine_amount": rng.randrange(5, 900, 5),
        }
        # ~6k tokens: large filler volume (long-document regime of LCR)
        docs[doc_id] = _render_doc(rng, doc_id, "cases", specs["cases"], values,
                                   FILLER["legal"], n_filler=320,
                                   intro="In the matter of the State versus the named defendant, the record follows.")
    all_ids = sorted(docs)
    return Corpus("legal", docs, {"cases": all_ids}, specs, {"cases": "cases"})


# ------------------------------------------------------------ swde corpus --


def _swde_specs():
    universities = {
        "university_name": AttrSpec("university_name", "str", "Name of the university.",
            ["Welcome to the admissions page of {}.", "This page is maintained by {}."],
            r"(?:admissions page of|maintained by) ([A-Z][a-zA-Z ]+University)"),
        "city": AttrSpec("city", "str", "City of the main campus.",
            ["The main campus sits in {}.", "Our campus address is in {}."],
            r"(?:campus sits in|address is in) ([A-Z][a-zA-Z ]+)\."),
        "enrollment": AttrSpec("enrollment", "int", "Total enrolled students.",
            ["Current enrollment stands at {} students.", "We serve {} students each year."],
            r"(\d+) students"),
        "founded": AttrSpec("founded", "int", "Founding year.",
            ["Founded in {}, the institution has a long history.", "Our story began in {}."],
            r"(?:Founded in|began in) (\d{4})"),
        "tuition": AttrSpec("tuition", "int", "Annual tuition in dollars.",
            ["Annual tuition is {} dollars.", "Tuition for the year totals {} dollars."],
            r"(?:tuition is|totals) (\d+) dollars"),
        "acceptance_rate": AttrSpec("acceptance_rate", "float", "Acceptance rate percentage.",
            ["The acceptance rate is {} percent.", "Roughly {} percent of applicants are admitted."],
            r"(\d+\.\d) percent"),
        "ranking": AttrSpec("ranking", "int", "National ranking position.",
            ["It holds national ranking number {}.", "Rankings place it at number {} nationally."],
            r"(?:ranking number|at number) (\d+)"),
        "mascot": AttrSpec("mascot", "str", "Athletics mascot.",
            ["Athletics teams compete as the {}.", "Students cheer for the {}."],
            r"(?:compete as the|cheer for the) ([A-Z][a-zA-Z]+)\."),
    }
    laptops = {
        "model_name": AttrSpec("model_name", "str", "Product model name.",
            ["Product listing for the {}.", "You are viewing the {}."],
            r"(?:listing for the|viewing the) ([A-Z][a-zA-Z]+ [A-Z0-9][a-zA-Z0-9]+)"),
        "price": AttrSpec("price", "int", "Retail price in dollars.",
            ["The retail price is {} dollars.", "Yours today for {} dollars."],
            r"(?:price is|for) (\d+) dollars"),
        "ram_gb": AttrSpec("ram_gb", "int", "Installed memory in gigabytes.",
            ["It ships with {} gigabytes of memory.", "Memory capacity: {} gigabytes."],
            r"(\d+) gigabytes"),
        "storage_tb": AttrSpec("storage_tb", "int", "Storage in terabytes.",
            ["Storage options start at {} terabytes.", "It includes {} terabytes of storage."],
            r"(\d+) terabytes"),
        "screen_inches": AttrSpec("screen_inches", "float", "Screen size in inches.",
            ["The display measures {} inches.", "A {} inch panel dominates the design."],
            r"(\d+\.\d) inch"),
        "weight_kg": AttrSpec("weight_kg", "float", "Weight in kilograms.",
            ["It weighs {} kilograms.", "Total weight comes to {} kilograms."],
            r"(\d+\.\d) kilograms"),
        "battery_hours": AttrSpec("battery_hours", "int", "Battery life in hours.",
            ["Battery life reaches {} hours.", "Expect up to {} hours of battery."],
            r"(\d+) hours"),
        "brand": AttrSpec("brand", "str", "Manufacturer brand.",
            ["It is manufactured by {}.", "A flagship machine from {}."],
            r"(?:manufactured by|machine from) ([A-Z][a-zA-Z]+)\."),
    }
    return {"universities": universities, "laptops": laptops}


def make_swde_corpus(seed: int = 2) -> Corpus:
    rng = random.Random(seed)
    specs = _swde_specs()
    docs = {}
    for i in range(100):
        doc_id = f"swde/universities/{i:03d}"
        values = {
            "university_name": f"{rng.choice(CITY_NAMES).split()[0]} {rng.choice(['State ', 'Tech ', ''])}University",
            "city": rng.choice(CITY_NAMES),
            "enrollment": rng.randrange(1_000, 60_000, 100),
            "founded": rng.randint(1800, 1990),
            "tuition": rng.randrange(8_000, 65_000, 500),
            "acceptance_rate": round(rng.uniform(4.0, 95.0), 1),
            "ranking": rng.randint(1, 300),
            "mascot": rng.choice(MASCOTS),
        }
        docs[doc_id] = _render_doc(rng, doc_id, "universities", specs["universities"],
                                   values, FILLER["web"], n_filler=4,
                                   intro="University admissions overview page.")
    for i in range(100):
        doc_id = f"swde/laptops/{i:03d}"
        values = {
            "model_name": f"{rng.choice(['Nova', 'Zen', 'Aero', 'Volt', 'Pixeler'])} {rng.choice(['X', 'Pro', 'Air', 'Ultra'])}{rng.randint(1, 9)}",
            "price": rng.randrange(400, 4000, 50),
            "ram_gb": rng.choice([8, 16, 32, 64]),
            "storage_tb": rng.choice([1, 2, 4]),
            "screen_inches": rng.choice([13.3, 14.0, 15.6, 16.2, 17.3]),
            "weight_kg": round(rng.uniform(0.9, 3.5), 1),
            "battery_hours": rng.randint(6, 24),
            "brand": rng.choice(["Lenark", "Dellux", "Asix", "Framewerk", "Macron"]),
        }
        docs[doc_id] = _render_doc(rng, doc_id, "laptops", specs["laptops"],
                                   values, FILLER["web"], n_filler=4,
                                   intro="Online electronics store product page.")
    all_ids = sorted(docs)
    tables = {t: list(all_ids) for t in specs}
    return Corpus("swde", docs, tables, specs, {t: t for t in specs})


CORPORA = {"wiki": make_wiki_corpus, "legal": make_legal_corpus, "swde": make_swde_corpus}
